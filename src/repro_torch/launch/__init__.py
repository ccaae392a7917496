"""Launchers and launch tools: the meshes (``launch.mesh``: the fleet
mesh, the training mesh, the production and debug meshes and the H100's
constants), the serving and training launchers (``launch.serve``,
``launch.train``), and the dry run of the production meshes with its
roofline tools (``launch.steps``, ``launch.counter``, ``launch.dryrun``,
``launch.memory``, ``launch.roofline``, ``launch.roofline_run``,
``launch.perf``)."""
