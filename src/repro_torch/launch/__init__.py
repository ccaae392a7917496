"""Launchers: the fleet mesh the sharded runtime places its shards on
(``launch.mesh``) and the serving launcher (``launch.serve``)."""
