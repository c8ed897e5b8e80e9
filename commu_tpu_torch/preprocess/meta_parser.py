"""CSV record -> MidiMeta parser (reference: commu/preprocessor/parser/meta.py:6-24).

A copy of ``commu_tpu/preprocess/meta_parser.py``."""
from __future__ import annotations

import re
from typing import Any, Dict

from ..utils.containers import MidiMeta

_INST_NUMBER_RE = re.compile("-[0-9]+")


def remove_number_from_inst(inst: str) -> str:
    """``"{inst}-[0-9]+"`` -> ``"{inst}"``."""
    return _INST_NUMBER_RE.sub("", inst)


class MetaParser:
    def parse(self, meta_dict: Dict[str, Any]) -> MidiMeta:
        fields = MidiMeta.field_names()
        kwargs = {}
        for field in fields:
            if field == "inst":
                kwargs[field] = remove_number_from_inst(meta_dict["inst"])
            else:
                kwargs[field] = meta_dict[field]
        # the csv stores chord_progressions (list-of-lists); MidiMeta doesn't
        # carry it — chords are consumed by the event encoder directly.
        return MidiMeta(**kwargs)
