"""Ported model families (`deepspeech`, the dense `transformer`) and the
`ModelApi` surface over them."""
