"""Ported model families (the DS2 slice: `deepspeech`)."""
