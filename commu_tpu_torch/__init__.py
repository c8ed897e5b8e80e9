"""ComMU in PyTorch for an NVIDIA H100: the preprocess, serving,
evaluation and training paths of ``commu_tpu``.

A port of the JAX package's preprocess pipeline (raw MIDI and a metadata
CSV -> key and BPM augmentation -> the npy corpus; pure Python over numpy,
no torch and no pandas), of its generation path (prefill, KV-cache decode,
the batched teacher-forcing sampler as captured CUDA graphs, MIDI
postprocessing), of its evaluation pass (the forward over the blocked-ring
XL memory, the fused NLL, ``Trainer.evaluate``) and of its training step
with dropout, with or without XL memory, to PyTorch, with every Pallas
kernel of the JAX package rewritten as a hand-written CUDA kernel for
``sm_90a`` (``csrc/``, built with nvcc at first use).
Imports torch, never JAX, and nothing of ``commu_tpu``: ``config``,
``vocab``, ``utils``, ``midi``, ``preprocess`` and ``data`` are this
package's own copies of the JAX-free modules of the same names.

- ``commu_tpu_torch.preprocess`` — augmentation, tokens, the npy corpus.
- ``commu_tpu_torch.ops``        — the kernels' wrappers and plain twins.
- ``commu_tpu_torch.models``     — Transformer-XL forward, XL memory,
  decode, checkpoints.
- ``commu_tpu_torch.generation`` — device sampler, pipeline, postprocessing.
- ``commu_tpu_torch.training``   — the train and eval steps and ``Trainer``.
- ``python -m commu_tpu_torch.preprocess`` — the preprocess CLI.
- ``python -m commu_tpu_torch.train``      — the training CLI.
- ``python -m commu_tpu_torch.generate``   — the CLI and serving loop.

The three CLIs chain as the reference's do: ``preprocess`` writes
``{root_dir}/output_npy``, ``train --data_dir`` reads it and writes
``checkpoint_best.pt``, ``generate --checkpoint_dir`` answers from it.
"""
