from cigwas_tpu.merge.merge_blocks import (
    BlockOutput,
    GlobalMergeResult,
    merge_block_outputs,
    reformat_cuskss_merged_output,
)
from cigwas_tpu.merge.sepselect import (
    MergedSkeleton,
    sepselect_merged,
    orient_v_structures_merged,
)
from cigwas_tpu.merge.mr_assumptions import IV_COLUMNS, get_iv_candidates, check_ivs

__all__ = [
    "BlockOutput",
    "GlobalMergeResult",
    "merge_block_outputs",
    "reformat_cuskss_merged_output",
    "MergedSkeleton",
    "sepselect_merged",
    "orient_v_structures_merged",
    "IV_COLUMNS",
    "get_iv_candidates",
    "check_ivs",
]
