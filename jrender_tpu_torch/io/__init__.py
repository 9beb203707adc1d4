from .image import imread, imwrite
from .load_obj import load_obj, load_mtl
from .save_obj import save_obj, save_voxel
