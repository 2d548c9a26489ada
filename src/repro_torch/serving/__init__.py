"""Serving engines: the continuous-batching LM engine and the streaming
speech fleet."""
from repro_torch.serving.engine import (FinishedRequest, GenerationResult,
                                        LMEngine, Request, SpeechResult,
                                        StreamingSpeechServer)

__all__ = ["FinishedRequest", "GenerationResult", "LMEngine", "Request",
           "SpeechResult", "StreamingSpeechServer"]
