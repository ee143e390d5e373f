"""Device ops of the port: the FLCT tile codec and FLCS kernels, their plain versions,
and the FLCS analysis, k scan and bit packer."""
