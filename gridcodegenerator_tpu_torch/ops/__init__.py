from . import blops
from . import kernels
