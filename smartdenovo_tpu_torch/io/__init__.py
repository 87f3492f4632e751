"""FASTA/FASTQ I/O (copy of smartdenovo_tpu/io)."""
