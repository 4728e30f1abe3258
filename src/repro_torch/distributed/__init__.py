"""Distributed runtime of the port: the cluster's straggler monitor
(``fault_tolerance``). Restart and elastic re-meshing come with the
training slice."""
