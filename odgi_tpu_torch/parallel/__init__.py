"""Multi-device PG-SGD (``sharded_strata``)."""
