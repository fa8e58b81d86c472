from .scene import (Scene, SceneMeta, GroupSpec, GroupArrays,  # noqa: F401
                    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
                    ROLE_FLUID)
from . import rigid_setup  # noqa: F401
