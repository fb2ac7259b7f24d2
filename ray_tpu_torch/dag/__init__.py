"""ray_tpu_torch.dag: compiled actor-method graphs with direct channels.

Role-equivalent to the reference's compiled graphs (aDAG)
(python/ray/dag/compiled_dag_node.py:805 + experimental/channel/*): a static
DAG of actor methods is compiled once into a pre-resolved execution schedule;
``execute()`` then streams values actor-to-actor over direct connections —
no per-hop driver round trip, no object-store traffic, and multiple
executions pipeline through the stages concurrently (sequence-numbered).

Redesign notes vs the reference: the reference's channels are mutable plasma
objects + NCCL channels with an exec loop per actor (``do_exec_tasks``); here
each participating CoreWorker gets a per-DAG stage table and a ``dag_push``
RPC — arrival of all inputs for a sequence number triggers the stage method
on the actor and pushes the result to the downstream stages' workers. The
driver holds only the input feed and the output future table.

Usage::

    with InputNode() as inp:
        x = preprocess.process.bind(inp)
        out = model.infer.bind(x)
    dag = out.experimental_compile()
    ref = dag.execute(batch)   # -> Future-like; .result() or await
"""
from ray_tpu_torch.dag.graph import DAGNode, InputNode, CompiledDAG

__all__ = ["DAGNode", "InputNode", "CompiledDAG"]
