from .container import GenerationInput
from .pipeline import MidiGenerationPipeline

__all__ = ["GenerationInput", "MidiGenerationPipeline"]
