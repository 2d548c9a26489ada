"""Serving engines (the DS2 slice: the streaming speech fleet)."""
from repro_torch.serving.engine import SpeechResult, StreamingSpeechServer

__all__ = ["SpeechResult", "StreamingSpeechServer"]
