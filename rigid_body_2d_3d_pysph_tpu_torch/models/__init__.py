from .base import Scheme, SchemeChooser  # noqa: F401
from .dem import DEMScheme  # noqa: F401
from .rigid_body import RigidBody2DScheme, RigidBody3DScheme  # noqa: F401
from .rigid_fluid_coupling import RigidFluidCouplingScheme  # noqa: F401
