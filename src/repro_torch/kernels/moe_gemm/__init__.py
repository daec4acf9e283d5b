from .ops import (expert_mlp, grouped_gemm, grouped_gemm_ref,  # noqa: F401
                  moe_grouped_gemm)
