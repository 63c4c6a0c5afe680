"""Distribution: [dp, tp] meshes of devices (`mesh`), the tensor-parallel
group a shard's forward reduces over (`group`), the Megatron weight shards
and the sharded forwards (`sharding`), and the multi-process runtime with
its leader-follower serving plane (`distributed`).  The submodules are
imported where they are used: the model code reaches `group` only."""
