from .geometry import (get_2d_block, get_3d_block, get_2d_tank,  # noqa: F401
                       hydrostatic_tank_2d, create_tank_2d_from_block_2d,
                       get_fluid_tank_3d, create_circle_1, create_circle)
