from .smf import (  # noqa: F401
    KeySignature,
    Instrument,
    Marker,
    MidiFile,
    Note,
    TempoChange,
    TimeSignature,
    key_name_to_number,
    key_number_to_name,
)
