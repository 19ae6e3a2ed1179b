"""parallel -- so far the int8 gradient round trip of ``compression.py``
(the mesh rules, the pipeline option and the compressed ring wait for the
multi-GPU port)."""
