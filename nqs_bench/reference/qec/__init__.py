"""The plain reference of the BB-LDPC memory cell: numpy and PyTorch only, no
module of the program. `frozen/` is a frozen copy of the host code that builds
the code, its memory-Z circuit and its detector error model; `bb_model` turns a
configuration file into that model, its exact marginals and a DEM sampler;
`decoder` is a flooding normalized min-sum decoder with OSD-0."""
