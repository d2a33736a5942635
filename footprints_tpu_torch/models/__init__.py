from .footprint import SCALES, FootprintNetwork
from .segmentor import Segmentor

__all__ = ["SCALES", "FootprintNetwork", "Segmentor"]
