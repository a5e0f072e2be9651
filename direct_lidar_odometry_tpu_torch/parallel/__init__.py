"""parallel subpackage of the PyTorch port: the keyframe pose graph."""
