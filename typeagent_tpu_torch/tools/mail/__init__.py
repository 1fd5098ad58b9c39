"""Mail dumpers: mailbox exports -> .eml files for ingest_email.

The port of ``typeagent_tpu/tools/mail/``: ``dump_mbox`` and
``print_timestamps`` (local files), ``dump_gmail`` (the Gmail REST API) and
``dump_outlook`` (Microsoft Graph), the last two over ``tools/rest.py``.
None touches a device.
"""
