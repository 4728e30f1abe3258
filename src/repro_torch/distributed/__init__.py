"""Distributed runtime of the port: the (data, model) device mesh
(``mesh``), the serve-mode sharding rules and shards (``sharding``), the
gathers at the model's hint sites (``hints``), the straggler monitor and
the training restart policy (``fault_tolerance``) and gradient
compression (``compression``). Training over a mesh and elastic
re-meshing are still to come."""
