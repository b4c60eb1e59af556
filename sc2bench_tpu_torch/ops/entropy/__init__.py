from .factorized import EntropyBottleneck  # noqa: F401
from .gaussian import GaussianConditional, get_scale_table  # noqa: F401
from .tables import (CodingTables, build_factorized_tables,  # noqa: F401
                     build_gaussian_tables)
