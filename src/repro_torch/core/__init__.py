from .sparse import SparseMatrix, random_sparse, power_law_sparse, banded_sparse, spmm_reference
from .partition import SextansParams, partition_windows, bin_rows_mod, cdiv
from .schedule import (schedule_nonzeros, verify_schedule,
                       min_dependency_distance, inorder_cycles, BUBBLE)
from .hflex import (pack_pe_streams, unpack_pe_streams, pack_block_slabs,
                    bucket_geometry, encode_a64, decode_a64)
