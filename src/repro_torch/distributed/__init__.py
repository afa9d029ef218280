"""Distributed training pieces of the port: the sharding rules and their
DTensor layouts (``sharding``), int8 gradient compression with error
feedback and the compressed all-reduce (``compression``), and fault
tolerance with the elastic mesh (``ft``).  The meshes themselves and the
process world are built by ``repro_torch.launch.mesh``."""
