from .mesh import make_mesh, factor2, shard_plane, gbuffer_pspec, plane_pspec
from .halo import exchange_rows, exchange_cols, exchange_halo2d, tile_origin
from .sharded import (
    svgf_spatial_sharded, svgf_spatial_local, temporal_accumulate_local,
    pipeline_local, make_sharded_pipeline, make_sharded_train_step,
    history_sharding,
)
from .distributed import initialize, runtime_info
