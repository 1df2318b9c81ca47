"""Multi-device layer of the port: the process group, the device list,
BatchNorm over the global batch and the straight-through global sum."""
