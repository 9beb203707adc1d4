from .api import (rasterize_rgbad, rasterize, rasterize_silhouettes,
                  rasterize_depth, N3mrRasterizer, vertices_to_faces)
