# Copied unchanged from paddle_tpu/batch.py: it needs no jax, and the port imports
# nothing of the JAX package.
"""paddle.batch (reference ``python/paddle/batch.py``): wrap a sample
reader into a batch reader."""
__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError("batch_size must be a positive integer")

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
