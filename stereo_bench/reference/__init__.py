"""The plain reference the benchmark holds the program's outputs to.

Plain PyTorch, float32 with TF32 off; it imports nothing of the program
(``matcher.match_pair``)."""

from stereo_bench.reference.matcher import match_pair

__all__ = ["match_pair"]
