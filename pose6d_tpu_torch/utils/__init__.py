"""Host utilities of the port: profiling, small helpers, the YAML
subset reader."""
from .misc import quaternion_rotation_matrix  # noqa: F401
from .profiling import collect, profile_trace  # noqa: F401
