"""Scale-out: the instance mesh, its collectives and the instance-axis
sharded engines."""
