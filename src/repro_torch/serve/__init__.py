"""repro_torch.serve — bit-fluid serving on one device: batched CNN
inference, continuous-batching LM serving with speculative decoding and a
prefix cache, the closed control loop, and trace replay."""
from repro_torch.serve.accounting import (CostRecord, ImageStats,  # noqa: F401
                                          RequestStats, RuntimeStats,
                                          aggregate, predict_table)
from repro_torch.serve.cnn import CNNServeEngine  # noqa: F401
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.prefix_cache import (PrefixCache,  # noqa: F401
                                            PrefixEntry, PrefixHit)
from repro_torch.serve.runtime import ServeRuntime, SlotTable  # noqa: F401
from repro_torch.serve.traffic import (Trace, TraceReplayer,  # noqa: F401
                                       TraceRequest, summarize, synth_trace)
