"""Kernel measurement tools of the port (counterparts of tools/ of the JAX
package): `attached_bench` times K1 and K1-int16 on one per-round batch;
`probe.row_probe`, `probe.fusebody_probe` and `probe.int16_probe` split
K1's row, K4's fusion body and the int16 op set into kernels of their own.
Importing a module runs nothing; each tool's `main` takes `--device`.
"""
