"""Dataset preprocessing: raw MIDI and a metadata CSV -> key and BPM
augmentation -> meta and event tokens -> the npy corpus that ``data`` reads
(copies of the ``commu_tpu/preprocess`` modules of the same names; the CSV
is read without pandas).

    python -m commu_tpu_torch.preprocess --root_dir ./dataset \\
        --csv_path ./dataset/commu_meta.csv [--num_cores N]

Pure Python over numpy: no module here imports torch.
"""
from .event_codec import EventSequenceEncoder, decode_tokens_to_midi, encode_midi_to_tokens  # noqa: F401
from .meta_parser import MetaParser, remove_number_from_inst  # noqa: F401
from .pipeline import PreprocessPipeline  # noqa: F401
