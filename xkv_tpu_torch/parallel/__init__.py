"""Multi-process runtime of the port: process-group set-up
(``distributed``), the (data, model) layout of the ranks (``mesh``) and
tensor parallelism over kv heads (``sharding``)."""
