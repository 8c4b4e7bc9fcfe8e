"""Control plane: the reference's framework-free band plan, panadapter and
station databases (copies), and the receiver controller and link state
machine on the port's chain."""
