"""Several devices (or several shards of one device): the data mesh, the
sharded scans and their collectives."""
