"""Multi-process runtime of the port: process-group set-up
(``distributed``), the (data, model) layout of the ranks and its
collectives (``mesh``), and which shard of the weights and of the cache a
rank holds (``sharding``)."""
