"""ComMU in PyTorch for an NVIDIA H100: the serving, evaluation and training
paths of ``commu_tpu``.

A port of the JAX package's generation path (prefill, KV-cache decode, the
batched teacher-forcing sampler, MIDI postprocessing), of its evaluation
pass (the forward over the blocked-ring XL memory, the fused NLL,
``Trainer.evaluate``) and of its training step with dropout, with or
without XL memory, to PyTorch, with every Pallas kernel of the JAX package
rewritten as a hand-written CUDA kernel for ``sm_90a`` (``csrc/``, built
with nvcc at first use).
Imports torch, never JAX, and nothing of ``commu_tpu``: ``config``,
``vocab``, ``utils``, ``midi``, ``preprocess.event_codec`` and ``data`` are
this package's own copies of the JAX-free modules of the same names.

- ``commu_tpu_torch.ops``        — the kernels' wrappers and plain twins.
- ``commu_tpu_torch.models``     — Transformer-XL forward, XL memory,
  decode, checkpoints.
- ``commu_tpu_torch.generation`` — device sampler, pipeline, postprocessing.
- ``commu_tpu_torch.training``   — the train and eval steps and ``Trainer``.
- ``python -m commu_tpu_torch.generate`` — the CLI and serving loop.
- ``python -m commu_tpu_torch.train``    — the training CLI.
"""
