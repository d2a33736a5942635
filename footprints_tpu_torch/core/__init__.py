from .ops import np_pixel_disp_to_depth, np_sigmoid_to_depth, sigmoid_to_depth

__all__ = ["np_pixel_disp_to_depth", "np_sigmoid_to_depth", "sigmoid_to_depth"]
