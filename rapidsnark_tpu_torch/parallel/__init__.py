"""Multi-GPU proving on torch.distributed (counterpart of
`rapidsnark_tpu/parallel/`): multihost (the job, the Mesh, the three
collectives), pmsm (the sharded MSM), pntt (the four-step distributed
NTT)."""
