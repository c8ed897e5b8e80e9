"""Constants, containers, exceptions and logging shared by the package
(copies of the ``commu_tpu/utils`` modules of the same names)."""
from .constants import *  # noqa: F401,F403
from .containers import MidiInfo, MidiMeta  # noqa: F401
from .exceptions import CommuError, ErrorMessage, UnprocessableMidiError  # noqa: F401
