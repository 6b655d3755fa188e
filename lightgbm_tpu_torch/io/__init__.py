from .binning import BinMapper, BIN_TYPE_NUMERICAL, BIN_TYPE_CATEGORICAL

__all__ = ["BinMapper", "BIN_TYPE_NUMERICAL", "BIN_TYPE_CATEGORICAL"]
