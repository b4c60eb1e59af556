from .factorized import EntropyBottleneck  # noqa: F401
from .tables import CodingTables, build_factorized_tables  # noqa: F401
