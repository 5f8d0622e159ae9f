"""Host syncs per tick inside the port's ``fleet.tick`` spans: the CUDA
runtime calls that wait for the device (a stream, device or event
synchronize, or a blocking ``cudaMemcpy``) that start inside a tick. The
client's own fetch after the tick is not counted. Nothing to read without
the spans."""

from benchmark import spans

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy"}


def read(ctx):
    ticks = spans.ticks(ctx.trace)
    if not ticks:
        return None
    n = sum(1 for name, s, _ in ctx.trace.host
            if name in SYNCS and any(a <= s < b for _, a, b in ticks))
    return n / len(ticks)
