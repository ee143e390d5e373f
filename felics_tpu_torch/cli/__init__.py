"""Command-line tools of the port, mirroring felics_tpu/cli/ (and through
it the reference binaries), each taking ``--device`` (default ``cuda``)
where felics_tpu's take ``--backend``:

  cfelics — compress an image file to .fel
  dfelics — decompress a .fel to an image file
  vfelics — view a .fel file
  bfelics — cross-format corpus benchmark

Run from the repository root: ``python -m felics_tpu_torch.cli.cfelics -i
in.tiff -o out.fel --device cpu``. ``--device cuda`` on a host without CUDA
fails with a message and exit code 1; nothing falls back to the CPU.
"""
