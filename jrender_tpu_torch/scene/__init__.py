from .texture import Texture
from .light import Light
from .object import obj
from .descriptors import (GeometryDescption, MaterialDescption,
                          IlluminationDescption, MultipleRenderTargets)
from .render import Render
from .scene import Scene, load_obj as load_scene_obj
