"""The plain reference: CLIP, RPO and CoCoOp in plain PyTorch, float32.

It reads the OpenAI-layout state dict that the benchmark made, tokenizes
with its own frozen copy of the CLIP tokenizer, and imports nothing of the
program under test.  Every matrix product goes through a precision
(``precision.py``): float32 with TF32 off for the reference, float8 for
the control that the limits must reject.
"""
