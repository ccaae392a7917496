"""Data pipelines of the port: the synthetic LM stream of the training
step (``lm.SyntheticLM``) and the multi-camera patch-token stream
(``streams.CameraStreamPipeline``)."""
from repro_torch.data.lm import SyntheticLM, lm_batch_specs
from repro_torch.data.streams import CameraStreamPipeline

__all__ = ["SyntheticLM", "lm_batch_specs", "CameraStreamPipeline"]
