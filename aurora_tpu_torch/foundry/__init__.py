"""The serving stack's pieces the port has so far: the channel's file naming
(:mod:`aurora_tpu_torch.foundry.channel`)."""
