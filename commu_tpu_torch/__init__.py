"""ComMU in PyTorch for an NVIDIA H100: the serving and evaluation paths of
``commu_tpu``.

A port of the JAX package's generation path (prefill, KV-cache decode, the
batched teacher-forcing sampler, MIDI postprocessing) and of its evaluation
pass (the forward over the blocked-ring XL memory, the fused NLL,
``Trainer.evaluate``) to PyTorch, with the JAX package's Pallas kernels on
those paths rewritten as hand-written CUDA kernels for ``sm_90a``
(``csrc/``, built with nvcc at first use).  Imports torch and never JAX;
from ``commu_tpu`` it uses only the JAX-free modules (config, vocab, utils,
preprocess.event_codec, midi, data).

- ``commu_tpu_torch.ops``        — the kernels' wrappers and plain twins.
- ``commu_tpu_torch.models``     — Transformer-XL forward, XL memory,
  decode, checkpoints.
- ``commu_tpu_torch.generation`` — device sampler, pipeline, postprocessing.
- ``commu_tpu_torch.training``   — the eval step and ``Trainer.evaluate``.
- ``python -m commu_tpu_torch.generate`` — the CLI and serving loop.
"""
