"""Host-side IO (port of ``orion_tpu/io``): user-commandline parsing, config
converters, templating, versioning metadata."""
