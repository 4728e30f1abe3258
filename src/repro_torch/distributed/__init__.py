"""Distributed runtime of the port: the (data, model) device mesh
(``mesh``), the serve-mode sharding rules and shards (``sharding``), the
gathers at the model's hint sites (``hints``) and the cluster's
straggler monitor (``fault_tolerance``). Restart and elastic re-meshing
come with the training slice."""
