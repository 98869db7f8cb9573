from repro_torch.serve.engine import (
    DecodeEngine,
    Request,
    make_prefill,
    make_serve_step,
)

__all__ = ["DecodeEngine", "Request", "make_prefill", "make_serve_step"]
