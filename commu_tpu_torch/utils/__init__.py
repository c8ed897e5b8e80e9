"""Constants, containers, exceptions, logging and the preprocess helpers
shared by the package (copies of the ``commu_tpu/utils`` modules of the
same names)."""
from .constants import *  # noqa: F401,F403
from .containers import MidiInfo, MidiMeta  # noqa: F401
from .exceptions import CommuError, ErrorMessage, UnprocessableMidiError  # noqa: F401
from .chords import sync_key_augment  # noqa: F401
from .midi_meta_utils import get_time_signature, get_velocity_range  # noqa: F401
