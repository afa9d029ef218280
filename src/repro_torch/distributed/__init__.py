"""Distributed-training pieces of the port: int8 gradient compression with
error feedback (``compression``) and fault tolerance (``ft``).  The
collectives (``compressed_psum``), the elastic mesh and the shardings
wait for the device mesh (ROADMAP A8 item 6)."""
