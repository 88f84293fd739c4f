"""Cylon-style dataframe layer: padded columnar tables, local and
distributed operators, and the out-of-core shuffle."""
