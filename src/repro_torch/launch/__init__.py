"""Launch tooling of the port, after the JAX package's ``repro.launch``:
the card's published rates (``mesh``), abstract parameter, optimizer,
cache and input trees on the ``meta`` device (``specs``), and a dry-run
that counts each step's FLOPs and bytes without allocating
(``dryrun``). The JAX package's ``hlo_costs`` parses XLA's HLO and has no
counterpart here: ``torch.utils.flop_counter`` counts the products."""
