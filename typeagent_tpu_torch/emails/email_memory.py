"""Email memory conversation: customized query compile (verb aliases + noise
filter).

(Parity: reference emails/email_memory.py — emailVerbs.json loaded into the
alias table; noiseTerms.txt filters query term compilation.)

The port of ``typeagent_tpu/emails/email_memory.py``, with its data files
``emailVerbs.json`` and ``noiseTerms.txt`` copied beside it.
"""

from __future__ import annotations

import copy
import json
import os

from ..knowpro import answers, searchlang
from ..knowpro.conversation_base import ConversationBase
from ..knowpro.convfiles import FileSerializedConversation
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import Term
from ..models.result import Result
from .email_message import EmailMessage


class EmailMemorySettings:
    """Bundle of conversation settings + the email memory's LLM translators."""

    def __init__(self, conversation_settings: ConversationSettings) -> None:
        from ..models.adapters import create_chat_model

        conversation_settings.semantic_ref_index_settings.auto_extract_knowledge = True
        self.conversation_settings = conversation_settings
        model = create_chat_model(retrier=conversation_settings.chat_retrier)
        self.language_model = model
        self.query_translator = searchlang.create_search_query_translator(model)
        self.answer_translator = answers.create_answer_translator(model)


class EmailMemory(FileSerializedConversation, ConversationBase[EmailMessage]):
    """Email conversation memory with email-specific query handling."""

    message_type = EmailMessage

    def __init__(self, settings: ConversationSettings, name: str, tags: list[str]):
        super().__init__(settings, name, tags)
        self.noise_terms: set[str] = set()

    # Email-tuned defaults (reference email_memory.py): generous knowledge
    # match caps, fuzzy scope, verbs on.

    @staticmethod
    def create_lang_search_compile_options() -> searchlang.LanguageQueryCompileOptions:
        return searchlang.LanguageQueryCompileOptions(
            apply_scope=True, exact_scope=False, verb_scope=True, term_filter=None
        )

    @classmethod
    def create_lang_search_options(cls) -> searchlang.LanguageSearchOptions:
        return searchlang.LanguageSearchOptions(
            compile_options=cls.create_lang_search_compile_options(),
            exact_match=False,
            max_knowledge_matches=50,
            max_message_matches=25,
        )

    @staticmethod
    def create_answer_context_options() -> answers.AnswerContextOptions:
        return answers.AnswerContextOptions(
            entities_top_k=50, topics_top_k=50, messages_top_k=None, chunking=None
        )

    @classmethod
    async def create(
        cls,
        settings: ConversationSettings,
        name: str | None = None,
        tags: list[str] | None = None,
    ) -> "EmailMemory":
        instance = await super().create(settings, name, tags)
        await instance._configure_memory()
        return instance

    async def query(
        self,
        question: str,
        search_options: searchlang.LanguageSearchOptions | None = None,
        answer_options: answers.AnswerContextOptions | None = None,
    ) -> str:
        return await super().query(
            question,
            self._adjust_search_options(search_options),
            (
                answer_options
                if answer_options is not None
                else EmailMemory.create_answer_context_options()
            ),
        )

    async def query_debug(
        self,
        search_text: str,
        query_translator: searchlang.SearchQueryTranslator,
        debug_context: searchlang.LanguageSearchDebugContext | None = None,
    ) -> Result[list[searchlang.ConversationSearchResult]]:
        return await searchlang.search_conversation_with_language(
            self,
            query_translator,
            search_text,
            self._adjust_search_options(None),
            None,
            debug_context,
        )

    async def _configure_memory(self) -> None:
        self.settings.semantic_ref_index_settings.auto_extract_knowledge = True
        await add_synonyms_file_as_aliases(self, "emailVerbs.json", clean=True)
        add_noise_words_from_file(self.noise_terms, "noiseTerms.txt")

    async def _after_deserialize(self, rebuild_related_terms: bool) -> None:
        if rebuild_related_terms:
            await add_synonyms_file_as_aliases(self, "emailVerbs.json", clean=True)

    def _adjust_search_options(
        self, options: searchlang.LanguageSearchOptions | None
    ) -> searchlang.LanguageSearchOptions:
        """Install the noise-term filter without mutating caller options."""
        options = options or type(self).create_lang_search_options()
        compile_options = options.compile_options
        options.compile_options = (
            copy.copy(compile_options)
            if compile_options is not None
            else type(self).create_lang_search_compile_options()
        )
        options.compile_options.term_filter = self._is_searchable_term
        return options

    def _is_searchable_term(self, term: str) -> bool:
        return term not in self.noise_terms


def _data_file(file_name: str) -> str | None:
    path = os.path.join(os.path.dirname(__file__), file_name)
    return path if os.path.exists(path) else None


async def add_synonyms_file_as_aliases(
    conversation: ConversationBase, file_name: str, clean: bool
) -> None:
    """Load a {term, relatedTerms} JSON file into the alias table."""
    indexes = conversation.secondary_indexes
    assert indexes is not None and indexes.term_to_related_terms_index is not None
    aliases = indexes.term_to_related_terms_index.aliases

    path = _data_file(file_name)
    if path is None:
        return
    with open(path) as f:
        entries: list[dict] = json.load(f)
    if not entries:
        return

    async with conversation.settings.storage_provider:
        if clean:
            await aliases.clear()
        for entry in entries:
            text, synonyms = entry.get("term"), entry.get("relatedTerms")
            if not (text and synonyms):
                continue
            target = Term(text=text.lower())
            for synonym in synonyms:
                await aliases.add_related_term(synonym.lower(), target)


def add_noise_words_from_file(noise: set[str], file_name: str) -> None:
    path = _data_file(file_name)
    if path is None:
        return
    with open(path) as f:
        noise.update(word for word in map(str.strip, f) if word)
