from .benchmarks import EditInstruction, load_benchmark
from .dataset import ImageCaptionDataset, InfiniteSampler, load_and_preprocess, make_train_iterator

__all__ = ["EditInstruction", "load_benchmark", "ImageCaptionDataset", "InfiniteSampler",
           "load_and_preprocess", "make_train_iterator"]
