from .footprint import SCALES, FootprintNetwork

__all__ = ["SCALES", "FootprintNetwork"]
