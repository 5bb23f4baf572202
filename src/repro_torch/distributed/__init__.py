"""Distribution layer of the PyTorch port: the seed-parallel ``fanout``
and episode-parallel ``dist_reinforce`` (``dist_search``) and the
latter's meshes and reductions (``collectives``); the LM's sharding rules
and activation policies on a ``DeviceMesh`` (``sharding``) and its GPipe
pipeline over ``torch.distributed`` ranks (``pipeline``)."""
