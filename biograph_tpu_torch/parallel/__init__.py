"""Multi-GPU: the entry-sharded seqset and discovery engine over
``torch.distributed``, and region- and read-sliced distributed discovery.

Counterpart of ``biograph_tpu/parallel/``.  ``distributed.initialize`` brings
up the process group (NCCL on the card, gloo on the host), ``mesh`` lays
processes and their local shards out as named axes, ``sharded_seqset`` and
``sharded_discovery`` answer every seqset query of discovery over a
structure sharded by entry range with one ``all_reduce`` a query, and
``discovery`` splits a discovery run over processes through a shared run
directory.
"""
