"""CrossRoI in PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(``sm_90a``): the offline phase, the online fleet step and its RoI-packed
transformer serving.

The offline phase (``core``: the scene, noisy ReID, the tandem filters,
the association table, the set cover, tile grouping, the codec model and
the online metrics; ``fleet.topology`` and ``fleet.runtime.
run_fleet_offline``/``run_fleet_online``) and the streaming runtime
(``net.links``, ``net.batcher``: uplinks, ``simulate_transport``, the
deadline group former) are host numpy, copies of the JAX package's;
``obs`` records spans and metrics on every path (off by default).  The
package runs the delta-gated fleet step: the cold super-launch
(``fleet.runtime.fleet_inference_step``) and the warm, changed-tiles-only
step (``fleet.runtime.fleet_reuse_step``), with the gate's references on a
canvas or in packed per-tile windows; and the edge rate-control loop
around it (``net.encoder``: static-tile fractions, the rate controller,
the per-camera gate-threshold schedule); the deadline group former's
releases (``net.batcher.DeadlineGroupFormer``); and the detector's
single-camera path (``RoIDetector.roi_forward``, ``forward``) and
per-layer chains
(``roi_forward_layers``, ``fleet_forward_layers``); and the RoI-packed
serving engine (``serving.engine.ServingEngine``: packed prefill of the
kept patch tokens, batched greedy decode over a persistent cache ring;
``launch.serve``) for the decoder families (``configs``, ``models``:
dense and vlm, with sliding-window rings and gemma3's local/global
pattern, moe, rwkv6's recurrent ``ssm`` and zamba2's Mamba2 ``hybrid``
with its shared attention blocks; internvl2-26b, h2o-danube3-4b,
gemma3-27b, mistral-nemo-12b, deepseek-67b, deepseek-moe-16b,
qwen3-moe-235b-a22b, rwkv6-7b, zamba2-2.7b), and whisper-small's
encoder-decoder (``encdec``), served through ``models.model.prefill``
over audio frames and ``decode_step``; and the one-device training step
of every family (``models.model.train_loss`` with remat and the causal
block skip, ``optim.adamw``, ``data.lm.SyntheticLM``).
Thirteen CUDA kernels carry them, built from ``kernels/csrc`` with
``nvcc`` at first use:

* ``tile_delta_gate_canvas`` / ``tile_delta_gate`` -- per-tile delta
  stats against the reference canvas / packed reference windows (the
  reuse gate);
* ``tile_delta`` / ``tile_delta_halo`` -- one camera's per-tile body /
  edge-ring delta stats (the rate controller's feeds);
* ``roi_conv_entry`` -- gather + 3x3 conv + ReLU straight off the frames;
  ``roi_conv_fleet`` the same without ReLU, ``roi_conv`` on one camera's
  (ty, tx) rows;
* ``roi_conv_stack`` -- every later 3x3 conv + ReLU layer in one launch;
  ``roi_conv_packed`` -- one later layer, no ReLU (the per-layer chain);
* ``sbnet_scatter_fleet`` -- packed head tiles into the (C, H, W, A)
  canvas; ``sbnet_scatter`` / ``sbnet_gather`` -- one camera's tiles
  into / out of an (H, W, C) frame;
* ``roi_attention`` -- flash attention over RoI-packed tokens, causal on
  their original positions, with the causal block skip
  (``kernels.ops.roi_attention``; the engine's prefill runs the layers'
  ``blockwise_attention``, as the JAX engine does).

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version (``kernels/ref.py``).  Public layouts follow the JAX
package ``repro``: frames NHWC, weights HWIO, head (C_last, A), index
tables (n, 3) and (n, 8) int32, packed tokens (S, H, D), model
parameters as stacked ``(L, ...)`` tensors under the JAX names.  This
package imports neither ``jax`` nor anything of ``repro``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Raises when no device is given and there is no card --
    the port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return torch.device("cuda")


__all__ = ["resolve_device"]
