from .ops import np_sigmoid_to_depth, sigmoid_to_depth

__all__ = ["np_sigmoid_to_depth", "sigmoid_to_depth"]
