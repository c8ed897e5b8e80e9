"""Corpus loading and host-side batch packing.

Rebuild of the reference's ``ComMUDataset`` (reference: commu/model/dataset.py:18-237)
with TPU-first conventions:

- batches are **batch-major** ``[B, T]`` int32 numpy arrays with fully static
  shapes, ready to feed a jit-compiled step without relayout;
- the XL-style *continuation packing* of the training stream (each batch row
  keeps consuming one sequence across steps, raising a ``reset`` flag when a
  fresh sequence starts — dataset.py:117-183) is reproduced exactly, verified
  by a differential test against the reference iterator;
- eval iteration slides fixed ``bptt`` windows over a batch of sequences,
  resetting memory only at each batch start, with contiguous-block sharding
  across data-parallel ranks (dataset.py:185-237).

The on-disk format is the reference's: ``{input,target}_{split}.npy`` object
arrays of ragged int sequences saved with ``allow_pickle=True``
(dataset.py:74-87).  Either stack can consume the other's output.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from ..vocab.event_tokens import PAD_ID, VOCAB_SIZE

import logging

logger = logging.getLogger("ComMU")


@dataclasses.dataclass
class Batch:
    """One packed step of data.  ``reset`` marks rows whose sequence started
    this step (their memory must be masked out); ``token_count`` counts
    non-pad target positions."""

    inputs: np.ndarray       # [B, T] int32
    targets: np.ndarray      # [B, T] int32
    reset: np.ndarray        # [B] bool
    token_count: int


class Vocab:
    """Minimal vocab facade (reference: dataset.py:6-15)."""

    pad_id = PAD_ID

    def __len__(self) -> int:
        return VOCAB_SIZE


def _load_split(data_dir: Path, split: str) -> List[np.ndarray]:
    """Load ``input_{split}.npy`` + ``target_{split}.npy`` and concatenate the
    meta (input) and event (target) streams per sample, then prepend the pad
    token as BOS (reference: dataset.py:31-45,74-87)."""
    inputs = np.load(data_dir / f"input_{split}.npy", allow_pickle=True)
    targets = np.load(data_dir / f"target_{split}.npy", allow_pickle=True)
    out = []
    for meta, events in zip(inputs, targets):
        seq = np.concatenate([
            np.asarray(meta, dtype=np.int64),
            np.asarray(events, dtype=np.int64),
        ])
        out.append(np.insert(seq, 0, PAD_ID).astype(np.int32))
    return out


class ComMUDataset:
    """The preprocessed corpus plus its train/eval iterators.

    Quirk preserved from the reference: the *val* split doubles as the test
    split — ``valid`` and ``test`` load the same ``*_val.npy`` files
    (dataset.py:26-28,81-87).
    """

    def __init__(self, data_dir: str | Path):
        data_dir = Path(data_dir)
        self.vocab = Vocab()
        self._data = {
            "train": _load_split(data_dir, "train"),
            "valid": _load_split(data_dir, "val"),
        }
        self._data["test"] = self._data["valid"]
        self._lengths = {
            split: np.array([len(s) for s in seqs], dtype=np.int32)
            for split, seqs in self._data.items()
        }
        # load-time stats, mirroring the reference's prints (dataset.py:56-72)
        logger.info("Using pad token as BOS")
        logger.info(
            "Loaded data, #samples train/val/test: %d/%d/%d",
            len(self._data["train"]), len(self._data["valid"]),
            len(self._data["test"]))
        logger.info(
            "Avg length: %.1f/%.1f; #valid/test tokens: %d/%d",
            float(self._lengths["train"].mean()),
            float(self._lengths["valid"].mean()),
            self.num_tokens("valid"), self.num_tokens("test"))

    def split_data(self, split: str) -> List[np.ndarray]:
        return self._data[split]

    def split_lengths(self, split: str) -> np.ndarray:
        return self._lengths[split]

    def num_tokens(self, split: str) -> int:
        """Predictable target positions (sequence lengths minus the BOS)."""
        return int((self._lengths[split] - 1).sum())

    # ------------------------------------------------------------------
    # Training stream: continuation packing (reference: dataset.py:117-183)
    # ------------------------------------------------------------------
    def train_iterator(
        self,
        batch_size: int,
        bptt: int,
        *,
        split: str = "train",
        shuffle: bool = True,
        seed: Optional[int] = None,
    ) -> Iterator[Batch]:
        """Endless (when ``shuffle``) packed stream.

        Each of the ``batch_size`` rows consumes one permuted sequence at a
        time, ``bptt`` tokens per step; when a row's sequence is exhausted it
        takes the next unclaimed sequence and raises its ``reset`` flag.  When
        the permutation is exhausted, a shuffling iterator reshuffles and
        restarts all rows; a non-shuffling one stops (single epoch).
        """
        data = self._data[split]
        lengths = self._lengths[split]
        total = len(data)
        assert batch_size < total, (
            f"batch_size {batch_size} must be < #sequences {total}")

        perm = np.arange(total)
        rng = np.random.RandomState(seed) if shuffle else None
        if shuffle:
            rng.shuffle(perm)
        # Per-row cursor: (index into perm, position within that sequence).
        trackers = [(i, 0) for i in range(batch_size)]
        next_idx = batch_size

        while True:
            inputs = np.full((batch_size, bptt), PAD_ID, dtype=np.int32)
            targets = np.full((batch_size, bptt), PAD_ID, dtype=np.int32)
            reset = np.zeros(batch_size, dtype=bool)
            token_count = 0
            for i in range(batch_size):
                idx, pos = trackers[i]
                while idx < total:
                    seq_id = perm[idx]
                    seq_len = lengths[seq_id]
                    if pos + 1 >= seq_len:
                        idx, pos = next_idx, 0
                        trackers[i] = (idx, pos)
                        next_idx += 1
                        reset[i] = True
                        continue
                    n_new = min(seq_len - 1 - pos, bptt)
                    inputs[i, :n_new] = data[seq_id][pos:pos + n_new]
                    targets[i, :n_new] = data[seq_id][pos + 1:pos + 1 + n_new]
                    token_count += int(n_new)
                    trackers[i] = (idx, pos + n_new)
                    break
            if token_count == 0:
                if not shuffle:
                    return
                rng.shuffle(perm)
                trackers = [(i, 0) for i in range(batch_size)]
                next_idx = batch_size
                continue
            yield Batch(inputs, targets, reset, token_count)

    # ------------------------------------------------------------------
    # Eval stream: windowed, rank-sharded (reference: dataset.py:185-237)
    # ------------------------------------------------------------------
    def eval_iterator(
        self,
        batch_size: int,
        bptt: int,
        *,
        split: str = "valid",
        shard_index: int = 0,
        num_shards: int = 0,
    ) -> Iterator[Batch]:
        """Slide ``bptt`` windows over batches of full sequences.

        ``reset`` is all-True on the first window of each sequence batch and
        all-False on subsequent windows (memory carries across windows of the
        same sequences).  With ``num_shards > 0`` each shard takes a contiguous
        block of sequences, the last shard absorbing the remainder — the exact
        split of the reference's rank sharding (dataset.py:196-205).
        """
        data = self._data[split]
        lengths = self._lengths[split]
        if num_shards > 0:
            n = len(data)
            begin = n // num_shards * shard_index
            end = n if shard_index == num_shards - 1 else n // num_shards * (shard_index + 1)
            data = data[begin:end]
            lengths = lengths[begin:end]
        total = len(data)

        for batch_begin in range(0, total, batch_size):
            batch_end = min(batch_begin + batch_size, total)
            max_len = int(max(lengths[batch_begin:batch_end]))
            first_window = True
            for seq_begin in range(0, max_len - 1, bptt):
                inputs = np.full((batch_size, bptt), PAD_ID, dtype=np.int32)
                targets = np.full((batch_size, bptt), PAD_ID, dtype=np.int32)
                token_count = 0
                for i in range(batch_begin, batch_end):
                    if lengths[i] > seq_begin + 1:
                        n_new = min(seq_begin + bptt, int(lengths[i]) - 1) - seq_begin
                        row = i - batch_begin
                        inputs[row, :n_new] = data[i][seq_begin:seq_begin + n_new]
                        targets[row, :n_new] = data[i][seq_begin + 1:seq_begin + 1 + n_new]
                        token_count += int(n_new)
                reset = np.full(batch_size, first_window, dtype=bool)
                yield Batch(inputs, targets, reset, token_count)
                first_window = False


def save_corpus(data_dir: str | Path, split: str, inputs: List[np.ndarray],
                targets: List[np.ndarray]) -> None:
    """Write a split in the reference's object-array npy layout
    (reference: preprocessor.py:306-319)."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)

    def _object_array(items):
        arr = np.empty(len(items), dtype=object)
        for i, x in enumerate(items):
            arr[i] = np.asarray(x)
        return arr

    np.save(data_dir / f"input_{split}.npy", _object_array(inputs),
            allow_pickle=True)
    np.save(data_dir / f"target_{split}.npy", _object_array(targets),
            allow_pickle=True)
