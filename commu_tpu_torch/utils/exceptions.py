"""Exception hierarchy (reference: commu/preprocessor/utils/exceptions.py:4-13)."""
import enum


class ErrorMessage(str, enum.Enum):
    UNPROCESSABLE_MIDI_ERROR = "Unprocessable midi"


class CommuError(Exception):
    """Base error of the framework."""


class UnprocessableMidiError(CommuError):
    """A MIDI sample whose metadata or notes cannot be encoded."""
