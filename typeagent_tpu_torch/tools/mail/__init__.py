"""Mail dumpers: mailbox exports -> .eml files for ingest_email.

The port of ``typeagent_tpu/tools/mail/``: ``dump_mbox`` and
``print_timestamps``. The Gmail and Outlook dumpers, which reach cloud
APIs, are not ported yet (ROADMAP.md Queue 1).
"""
