"""Distributed runtime of the port: the (data, model) or (pod, data,
model) device mesh (``mesh``), the serve- and train-mode sharding rules
and shards (``sharding``), the gathers at the model's hint sites
(``hints``) and the train step's collectives (``collectives``), the
straggler monitor, the training restart policy and elastic re-meshing
(``fault_tolerance``) and gradient compression (``compression``)."""
