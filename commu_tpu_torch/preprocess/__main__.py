"""Dataset preprocessing: MIDI -> augmentation -> tokens -> npy.

The port's counterpart of the root ``preprocess.py``, with its three flags
(reference: preprocess.py:7-22):

    python -m commu_tpu_torch.preprocess --root_dir ./dataset \\
        --csv_path ./dataset/commu_meta.csv [--num_cores N]

It reads ``{root_dir}/{train,val}/raw/*.mid`` and writes
``{root_dir}/output_npy/{input,target}_{train,val}.npy``, which
``python -m commu_tpu_torch.train --data_dir {root_dir}/output_npy`` reads.
It imports neither torch nor pandas.
"""
import argparse
from multiprocessing import cpu_count
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser("dataset preprocessing")
    p.add_argument("--root_dir", type=str, required=True,
                   help="root directory containing '{split}/raw' directories")
    p.add_argument("--csv_path", type=str, required=True,
                   help="csv file path containing meta info")
    p.add_argument("--num_cores", type=int, default=max(1, cpu_count() - 4))
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..utils.logging import configure_logging
    configure_logging(None)
    from .pipeline import PreprocessPipeline

    PreprocessPipeline()(
        root_dir=Path(args.root_dir).expanduser(),
        csv_path=args.csv_path,
        num_cores=max(1, args.num_cores),
    )


if __name__ == "__main__":
    main()
