from .benchmarks import EditInstruction, load_benchmark

__all__ = ["EditInstruction", "load_benchmark"]
