from .timing import Timer, time_fn, mpix_per_s, print_device_properties, trace, CsvDump
from .tiling import spacing, halo_radius, tile_extent, halo_bytes
from . import checkpoint
