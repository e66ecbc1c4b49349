"""Sharding over a ``torch.distributed`` device mesh, after the JAX
package's ``repro.parallel``: logical-axis rules (``sharding``), the
collectives the port's sharded code uses and a launcher for a world of
ranks (``collectives``)."""
