"""parallel subpackage of the PyTorch port: the keyframe pose graph, the
multi-sequence batched step and its sharding over ``torch.distributed``."""
