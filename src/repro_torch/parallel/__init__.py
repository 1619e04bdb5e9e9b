"""Multi-device placement (port of ``repro.parallel``): the sharding rules
and the in-graph constraints, over ``torch.distributed``'s ``DeviceMesh``
and DTensor."""
