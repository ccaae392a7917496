"""Device meshes: the fleet mesh the sharded runtime places its shards on
(``launch.mesh``)."""
