"""Data pipelines of the port: the multi-camera patch-token stream
(``streams.CameraStreamPipeline``).  The JAX package's synthetic LM data
(``repro.data.lm``) comes with the training side."""
from repro_torch.data.streams import CameraStreamPipeline

__all__ = ["CameraStreamPipeline"]
