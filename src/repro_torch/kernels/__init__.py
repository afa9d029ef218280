"""Kernels written by hand for Hopper (sm_90a), each beside its plain
PyTorch version; ``ops`` picks one by the device of its inputs."""
