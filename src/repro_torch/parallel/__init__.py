"""The distribution layer (port of ``repro/parallel``): sharding rules
and ``constrain``, the ring collectives, the GPipe pipeline, and the
kernels' calls on DTensors."""
