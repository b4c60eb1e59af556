"""Importing this package fills the 'transform' and 'collate' registries
(the config's `dependencies` import it as the counterpart of
`sc2bench_tpu.transforms`)."""
from . import codec, collator, misc  # noqa: F401
