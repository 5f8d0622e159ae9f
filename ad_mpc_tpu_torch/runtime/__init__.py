"""The native host runtime of the port: UDP pub/sub, SPSC queue, rate timer."""

from ad_mpc_tpu_torch.runtime.bridge import (
    Publisher,
    RateTimer,
    SpscQueue,
    Subscriber,
    monotonic_ns,
)

__all__ = ["Publisher", "Subscriber", "SpscQueue", "RateTimer", "monotonic_ns"]
