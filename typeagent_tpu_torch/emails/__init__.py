"""Email domain adapter (the port of ``typeagent_tpu/emails/``)."""

from .email_import import (
    import_email_from_file,
    import_email_string,
    import_emails_from_dir,
    import_forwarded_email_string,
)
from .email_memory import EmailMemory, EmailMemorySettings
from .email_message import EmailMessage, EmailMessageMeta

__all__ = [
    "EmailMemory",
    "EmailMemorySettings",
    "EmailMessage",
    "EmailMessageMeta",
    "import_email_from_file",
    "import_email_string",
    "import_emails_from_dir",
    "import_forwarded_email_string",
]
