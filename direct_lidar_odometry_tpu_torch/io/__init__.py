"""io subpackage of the PyTorch port."""
