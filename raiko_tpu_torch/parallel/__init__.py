"""Multi-GPU distribution layer (SURVEY.md §2.3, §7 step 7).

Port of raiko_tpu/parallel.  The role NCCL/MPI plays elsewhere is filled
by ``torch.distributed`` collectives over a process group, one process a
rank (SPMD: every rank runs the same code on the same replicated inputs,
and a collective stands where the reference's ``shard_map`` had one):
NCCL with one GPU a rank, or gloo with several ranks on one GPU or on the
CPU.  Components: distributed NTT (all-to-all four-step), distributed MSM
(per-rank bucket matrices + collective EC reduction), sharded STARK trace
commitment, and the prover's sharded column commitment
(``stark.prover.set_mesh``).  ``mesh`` holds the ``Mesh`` (the group, this
rank's device, its rank and the group's size), the collectives and the
launcher ``run_ranks``; ``dryrun`` drives all of it against the
single-device path."""
