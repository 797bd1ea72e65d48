"""Serving-mesh parallelism over ``torch.distributed``: the mesh context and
parameter placement (``sharding``) and the collectives (``collectives``)."""
