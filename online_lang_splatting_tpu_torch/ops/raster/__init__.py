from .api import RasterOutput, RasterSettings, rasterize  # noqa: F401
