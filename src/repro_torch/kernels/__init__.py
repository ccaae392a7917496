"""The port's kernels: CUDA C++ sources under ``csrc/``, their launchers
(``tile_delta``, ``roi_conv``, ``sbnet``), the plain PyTorch versions
(``ref``) and the counting wrappers with the host tables (``ops``)."""
