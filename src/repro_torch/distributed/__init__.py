"""Distribution: the training state's sharding rules and placements, the
model group's autograd collectives (``distributed.tensor_parallel``),
the int8 gradient all-reduce, fault tolerance, and the sharded fleet
runtime's placement over a fleet mesh (``distributed.shardings``)."""
