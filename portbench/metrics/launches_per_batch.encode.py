"""CUDA kernel launches a batch of the FLAC encode: the kernels on the
card in the traced window (copies and fills left out) over the batches
the encoder submitted (``flac_enc_fast.wire_batches``)."""


def read(ctx):
    batches = ctx["counters"].get("encode_batches")
    if ctx["driver"] != "encode" or ctx["trace"] is None or not batches:
        return None
    return ctx["trace"]["launches"] / batches
