from .options import Options
