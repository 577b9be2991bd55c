"""paddle_tpu_torch.inference.serving — continuous-batching decode
server over a paged KV cache, with ragged paged decode attention as a
hand-written CUDA kernel on the card, the decode step as one captured
CUDA graph, chunked prefill, a shared-prefix cache, speculative
decoding (draft, verify and accept in one captured step), and the
disaggregated tier: prefill and decode roles joined by page migration,
with the SLO router (``ServingRouter``) and ``DisaggRouter``.

    from paddle_tpu_torch.inference.serving import (LLMServer,
                                                    params_from_numpy)
    server = LLMServer(params=params_from_numpy(tree, device="cuda"),
                       gpt_config=cfg, max_batch=8, num_blocks=512,
                       prefill_chunk=512, prefix_cache=True)
    print(server.submit(prompt_ids, max_tokens=64).result().tokens)
"""

from .kv_cache import (BlockAllocator, OutOfBlocks, PagedKVCache,
                       PageTable, SCRATCH_BLOCK, gather_pages,
                       paged_append, write_prompt_pages,
                       write_prompt_pages_group)
from .ragged_attention import (DENOM_TINY, MASK_VALUE,
                               causal_prefill_attention,
                               chunked_prefill_attention,
                               paged_decode_attention,
                               ragged_decode_attention)
from .paged_attention_kernel import (paged_ragged_attention,
                                     paged_ragged_attention_reference)
from .sampling import (gumbel_noise, sample_tokens, sample_tokens_grid,
                       sample_tokens_host)
from .decode_model import (GPTDecodeWeights, ServingModelConfig,
                           chunk_prefill_forward, decode_forward,
                           extract_decode_params, params_from_numpy,
                           prefill_forward, prefill_group_forward,
                           reference_decode, spec_score_forward)
from .spec_decode import SPEC_SENTINEL, spec_decode_step
from .prefix_cache import PrefixCache, PrefixEntry
from .scheduler import QueueFull, Request, RequestStats, Scheduler
from .migration import (MigrationError, PageMigration,
                        gather_request_pages, scatter_request_pages)
from .engine import DecodeEngine, ENGINE_ROLES, GenerationResult
from .api import LLMServer, filter_spec_stream
from .router import Overloaded, ROUTER_PHASES, ServingRouter
from .disagg import DisaggRouter

__all__ = [
    "BlockAllocator", "OutOfBlocks", "PagedKVCache", "PageTable",
    "SCRATCH_BLOCK", "gather_pages", "paged_append",
    "write_prompt_pages", "write_prompt_pages_group",
    "DENOM_TINY", "MASK_VALUE", "causal_prefill_attention",
    "chunked_prefill_attention", "paged_decode_attention",
    "ragged_decode_attention",
    "paged_ragged_attention", "paged_ragged_attention_reference",
    "gumbel_noise", "sample_tokens", "sample_tokens_grid",
    "sample_tokens_host",
    "GPTDecodeWeights", "ServingModelConfig", "chunk_prefill_forward",
    "decode_forward", "extract_decode_params", "params_from_numpy",
    "prefill_forward", "prefill_group_forward", "reference_decode",
    "spec_score_forward", "SPEC_SENTINEL", "spec_decode_step",
    "PrefixCache", "PrefixEntry",
    "QueueFull", "Request", "RequestStats", "Scheduler",
    "MigrationError", "PageMigration", "gather_request_pages",
    "scatter_request_pages",
    "DecodeEngine", "ENGINE_ROLES", "GenerationResult", "LLMServer",
    "filter_spec_stream",
    "Overloaded", "ROUTER_PHASES", "ServingRouter", "DisaggRouter",
]
