"""The distributed sort: the sample sort over a mesh of shards."""
